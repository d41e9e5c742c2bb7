"""Inputs drawn on the device from the seed."""
