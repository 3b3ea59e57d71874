"""Glue between precision policies and the transformer stack."""
