"""butil — base utilities (reference: src/butil/)."""
