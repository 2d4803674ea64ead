"""Entity and link tables, and the part-selector algebra."""
