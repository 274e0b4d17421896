"""One module per traffic kind; a traffic mix names its driver."""
