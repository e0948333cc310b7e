"""Measurement tools of the port (run on the card as ``python -m``)."""
