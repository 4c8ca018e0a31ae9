"""Host-side image IO and normalisation for prediction."""
