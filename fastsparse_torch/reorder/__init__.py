"""Row and column orderings for tile density and segment locality."""
