"""Launchers: the LM train steps (``train``)."""
