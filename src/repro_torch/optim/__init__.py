"""Optimizers of the port (AdamW, Adafactor) and their schedules."""
