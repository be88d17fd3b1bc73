"""One module per traffic driver, named by a traffic file's ``driver``: each
runs a cell once (``run``) and returns its end-to-end numbers, the numbers
compared, and the context the per-layer readers read."""
