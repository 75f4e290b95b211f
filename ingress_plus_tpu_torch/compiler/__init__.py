"""Compiled-pack model: rule metadata, bitap tables, the loader."""
