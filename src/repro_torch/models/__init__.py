"""Model families of the port (dense transformer) and packed CIM deploys."""
