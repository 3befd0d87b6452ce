"""Config, logging and the factories of the CLI."""
