"""Networks of the port."""
