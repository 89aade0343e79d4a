"""Host-side utilities: file IO for the stores."""
