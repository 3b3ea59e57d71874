"""Model layers: norms, RoPE, embeddings, attention, MLP, the decoder, and
the paper's CNNs."""
