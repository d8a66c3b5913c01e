"""Tacotron model blocks (inference)."""
