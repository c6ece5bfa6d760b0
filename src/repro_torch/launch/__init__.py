"""Launchers: the lockstep server."""
