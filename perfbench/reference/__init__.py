"""The plain reference and the input generator, independent of the port."""
