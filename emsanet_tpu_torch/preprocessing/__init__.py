"""Host-side preprocessing and batch collation (numpy), train phase."""
