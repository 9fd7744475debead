"""Registration algorithm families."""
