"""Step factories (serving only in this slice; training comes next)."""
