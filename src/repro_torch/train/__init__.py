"""Serve steps of the LM substrate; training waits (ROADMAP queue 1 item 12)."""
