"""Log-mel frontend."""
