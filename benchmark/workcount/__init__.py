"""Frozen work counts and the card's peak rates, for roofline shares."""
