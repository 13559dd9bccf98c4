"""Paper-plane workload configurations."""
