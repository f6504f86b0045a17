"""Tools of the port, run as modules."""
