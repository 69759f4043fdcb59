"""The train step (`steps`) and its virtual client mesh (`mesh`)."""
