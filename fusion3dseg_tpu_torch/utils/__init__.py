"""Host-side tables and helpers: palettes, the COCO-133 taxonomy."""
