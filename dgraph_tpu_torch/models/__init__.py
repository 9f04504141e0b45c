"""Data model: scalar types, schema state, tokenizers, posting lists."""
