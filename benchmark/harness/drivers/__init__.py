"""Drivers, one per way of offering traffic; a traffic file names its
driver under ``driver``."""
