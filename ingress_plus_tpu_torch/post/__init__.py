"""Post plane pieces the serve plane needs (the bounded top-k sketch)."""
