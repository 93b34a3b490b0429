"""Consensus: so far the startup handshake (`replay.Handshaker`)."""
