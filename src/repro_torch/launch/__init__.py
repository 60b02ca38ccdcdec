"""Launchers: serving and training on one device, and the cells mesh over
the default process group."""
