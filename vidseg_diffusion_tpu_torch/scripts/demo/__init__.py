"""The browser demo server and the sampling demo CLI of the PyTorch port."""
