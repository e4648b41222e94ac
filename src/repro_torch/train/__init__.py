"""Training runtime: optimizer and train step."""
