"""Training of the port on one device: the loss and the train step."""
