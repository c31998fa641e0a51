"""Evaluation: image metrics and eval networks, view consistency, the paired
and consistency harnesses with their metric batteries, the relay report."""
