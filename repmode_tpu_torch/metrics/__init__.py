"""Per-volume metrics and their aggregation."""
