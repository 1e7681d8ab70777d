"""Expressions and the primitive dispatch points of the port."""
