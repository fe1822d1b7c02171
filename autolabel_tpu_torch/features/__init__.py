"""Teacher feature extractors: only the offline text stand-in is ported."""
