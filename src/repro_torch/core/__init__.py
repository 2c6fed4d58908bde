"""FREYJA core in torch: profiles, predictor, labels and discovery."""
