"""Image and histogram ops of the PyTorch port."""
