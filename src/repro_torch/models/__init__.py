"""Model families (the decoder-only transformer with its MLP or MoE FFN,
the encoder-decoder and mamba2) and their layers."""
