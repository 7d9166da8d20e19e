"""Pipeline entry points: the 2D segmenter and the streaming voter."""
