"""Helpers over parameter and state trees."""
