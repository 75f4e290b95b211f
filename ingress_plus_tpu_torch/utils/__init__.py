"""Device selection and the synthetic traffic corpus."""
