"""Launchers: the serving launcher on one device."""
