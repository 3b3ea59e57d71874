"""Model layers: norms, RoPE, embeddings, attention, MLP, the decoder."""
