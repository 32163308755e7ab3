"""Plain references, one module a model family, named by a configuration
file's ``reference`` key.  They import neither JAX nor the program."""
