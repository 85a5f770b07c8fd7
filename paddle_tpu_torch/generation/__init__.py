"""Serving on the paged KV cache (``serving.ServingEngine``) and its decode
program cache (``program_cache``)."""
