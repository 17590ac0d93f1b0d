"""Instruments of the port that run on the card (``vpu_probe``)."""
