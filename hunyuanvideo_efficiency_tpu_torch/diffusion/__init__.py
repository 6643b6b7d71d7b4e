"""Flow-matching scheduler and the text-to-video pipeline."""
