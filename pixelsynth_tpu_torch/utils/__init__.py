"""Utilities: video assembly."""
