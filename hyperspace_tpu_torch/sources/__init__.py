"""Source providers: adapters from scan relations to indexable metadata."""
