"""Evaluation harnesses: closed-loop kick quality."""
