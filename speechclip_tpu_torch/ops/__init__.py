"""Elementwise, masking, transformer and retrieval ops of the port."""
