"""Fault vocabulary of the port (see ``manager``)."""
