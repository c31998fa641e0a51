"""Evaluation: image metrics, view consistency, the relay report."""
