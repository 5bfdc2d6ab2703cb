"""The dilated conv layer and the AtacWorks stack built on it."""
