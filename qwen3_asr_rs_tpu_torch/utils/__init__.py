"""Host-side utilities: stage timing and error rates."""
