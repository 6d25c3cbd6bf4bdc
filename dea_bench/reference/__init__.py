"""The plain reference that decides a run's ``correct``."""
