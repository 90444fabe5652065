"""Fault vocabulary and the train loop's fault manager (see ``manager``)."""
