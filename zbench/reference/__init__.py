"""Plain NumPy references, one module a schema named in a configuration.  They import nothing of the program."""
