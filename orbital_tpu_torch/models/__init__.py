"""Host-side scene definition: constants and scene arrays."""
