"""The hash-field NeRF: encoding, model, rays, render, metrics, API."""
