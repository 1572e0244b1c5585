"""Traffic generators, one module each; a traffic file names its
generator."""
