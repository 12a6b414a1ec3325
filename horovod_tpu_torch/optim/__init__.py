"""The data-parallel optimizer of the port."""
