"""Command-line probes of the port, run on the card."""
