"""Host-side assembly of ordered k-min-mer streams from padded batches."""
