"""Measurement tools run on the card; nothing on a calibration path
imports them."""
