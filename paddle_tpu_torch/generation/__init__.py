"""Serving on the paged KV cache (``serving.ServingEngine``)."""
