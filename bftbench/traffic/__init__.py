"""Traffic generators, one per kind; the mixes are the JSON files."""
