"""Launchers: step functions and the batched server."""
