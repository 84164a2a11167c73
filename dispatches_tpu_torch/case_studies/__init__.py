"""Case studies of the port."""
