"""Data input and output of the port; ``png`` reads and writes the PNG
files the serving path takes and gives."""
