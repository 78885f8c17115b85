"""Audio encoder and text decoder."""
