"""Host-side preprocessing and batch collation (numpy and the host
library)."""
