"""AdamW and learning-rate schedules, written as the JAX package's are."""
