"""Model definitions: the Llama-3 decoder's serving surface."""
