"""Model families (the dense transformer so far) and their layers."""
