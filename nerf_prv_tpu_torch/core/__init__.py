"""Camera config, transforms.json schema and look-at poses (numpy only)."""
