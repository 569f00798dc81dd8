"""Host-side input ingestion: sequence file parsing and 2-bit packing."""
