"""Entry points that drive the port end to end."""
