"""Host-side request model, unpacking and normalization."""
