"""Data helpers: the text tokenizer."""
