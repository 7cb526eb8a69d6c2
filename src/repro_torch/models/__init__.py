"""Model families (the dense transformer and mamba2 so far) and their
layers."""
