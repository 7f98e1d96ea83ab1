"""Model stack of the port (dense GQA text decoders in this slice)."""
