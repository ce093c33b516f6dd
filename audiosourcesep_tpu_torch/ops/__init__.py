"""Ops: the Winograd conv kernel and the audio front end."""
