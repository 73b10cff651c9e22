"""Roofline bounds of the port's programs on the card."""
