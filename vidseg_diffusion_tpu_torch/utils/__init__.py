"""Training utilities of the PyTorch port: EMA and LR schedules."""
