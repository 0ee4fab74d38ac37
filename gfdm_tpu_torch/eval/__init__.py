"""Evaluation sweeps of the modem: the coded service's sensitivity."""
