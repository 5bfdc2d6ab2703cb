"""Step factories: training (``train_step``) and serving (``serve_step``)."""
