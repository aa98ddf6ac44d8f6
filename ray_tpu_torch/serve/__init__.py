"""Serving: the paged continuous-batching LLM engine."""
