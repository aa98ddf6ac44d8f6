"""Model definitions: the Llama-3 decoder (serving and training) and the
Mixtral-style MoE family on its trunk."""
