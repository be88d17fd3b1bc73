"""Weight bridges into the port."""
