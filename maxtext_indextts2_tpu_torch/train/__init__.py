"""Training-side helpers the serving path shares (the text tokenizer)."""
