"""Shape padding onto fixed serving signatures."""
